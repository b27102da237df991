"""The port's groups mesh over several devices: one slab per shard, on that
shard's device, driven by one controller.

``make_group_mesh(S, "cpu")`` puts each shard's ``(Gl, ...)`` slab in an
allocation of its own; the CPU tests hold such a service against
the reference's unsharded ``MultiGroupDataplane`` and against per-group
single-group twins, the triangle of ``tests/test_sharded_multigroup.py``
and ``tests/test_multidevice.py`` (the reference's own sharded path fails
under jax 0.9.0, so it is never the oracle).  ``use_kernels`` runs K1's
shard slice's and K6's plain versions here.  Distinct cards are checked
without a card: under ``FakeTensorMode``, with ``torch.cuda`` patched to
four cards, every operation of a dispatch, a group's vote, a crash and
restore, a takeover and a recovery is logged with the devices it touches.
Tolerance: none, every int32 equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import failover  # noqa: E402
from repro_torch.core.bridge import export_state, import_state  # noqa: E402
from repro_torch.core.paxos import Coordinator as SoftCoordinator  # noqa: E402
from repro_torch.launch.mesh import make_group_mesh  # noqa: E402

V = 4  # value words: a 16-byte value holds the tests' payloads and their header


def _cfg(pkg, g, **kw):
    base = dict(n_acceptors=3, n_instances=128, batch=16, n_groups=g, value_words=V)
    return pkg.PaxosConfig(**{**base, **kw})


def _cpu_mesh(shards: int):
    return make_group_mesh(shards, "cpu")


def _same(a, b) -> None:
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _ref_slabs(hw) -> list[np.ndarray]:
    return [np.asarray(x) for x in (*vars(hw.stack).values(), *vars(hw.lstate).values())]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_over_devices_equals_unsharded(shards, g, use_kernels):
    """S shards, each slab its own: full-width rounds and cohorts equal the
    reference's unsharded dataplane bit for bit, with the frozen group and
    the dead acceptor on distinct shards, and so do the gathered slabs."""
    ref = R.MultiGroupDataplane(_cfg(R, g))
    sh = T.ShardedMultiGroupDataplane(_cfg(T, g), mesh=_cpu_mesh(shards), use_kernels=use_kernels)
    assert sh.n_shards == shards and len(sh.stacks) == len(sh.lstates) == shards
    frozen, casualty = 2, g - 1
    assert sh.shard_of_group(frozen) != sh.shard_of_group(casualty)
    rng = np.random.default_rng(3)
    for hw in (ref, sh):
        hw.kill_acceptor(casualty, 1)
        hw.freeze_group(frozen)
    cohorts = [[0, g - 1], [1, 3, g // 2], list(range(0, g, 2))]
    for r in range(3):
        vals = rng.integers(-50, 50, (g, 16, V)).astype(np.int32)
        act = np.ones((g, 16), bool)
        _same(ref.pipeline(vals, act), sh.pipeline(vals, act))
        gids = cohorts[r]
        cv = rng.integers(-50, 50, (len(gids), 16, V)).astype(np.int32)
        ca = np.ones((len(gids), 16), bool)
        _same(ref.pipeline_cohort(gids, cv, ca), sh.pipeline_cohort(gids, cv, ca))
    for hw in (ref, sh):
        hw.restore_group(frozen, 0, 1)
    vals = rng.integers(-50, 50, (g, 16, V)).astype(np.int32)
    act = np.ones((g, 16), bool)
    _same(ref.pipeline(vals, act), sh.pipeline(vals, act))
    _same(_ref_slabs(ref), sh.gather().values())
    assert sh.dispatch_count == ref.dispatch_count


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("shards", [2, 4])
def test_live_migration_across_shards_matches_twins(shards, use_kernels):
    """Live slab migration onto another shard's device: skewed load, a
    retire on the last shard, then the hot tenant moves there from shard 0
    while the service runs; every group's decided stream equals its
    single-group twin's, and the moved group's rows live on the last
    shard's slab."""
    g = 4
    kw = dict(n_acceptors=3, n_instances=256, batch=16, value_words=4)
    ctx = T.PaxosContext(T.PaxosConfig(n_groups=g, **kw), mesh=_cpu_mesh(shards),
                         use_kernels=use_kernels, snapshots=True, device="cpu")  # fmt: skip
    twins = [R.PaxosContext(R.PaxosConfig(**kw), use_kernels=use_kernels, fused=True,
                            snapshots=True) for _ in range(g)]  # fmt: skip
    rng = np.random.default_rng(1)

    def waves(n, groups, hot=0):
        for w in range(n):
            for gid in groups:
                for _ in range(12 if gid == hot else (2 if w % 2 == 0 else 1)):
                    p = bytes(rng.integers(0, 255, 6).astype(np.uint8))
                    ctx.submit(p, group=gid)
                    twins[gid].submit(p)
            ctx.run_until_quiescent()
            for gid in groups:
                twins[gid].run_until_quiescent()

    waves(4, [0, 1, 2, 3])
    hw = ctx.hw
    assert hw.placement.identity_map()
    ctx.retire_group(3)  # vacates a slot on the last shard
    assert hw.shard_of_group(0) == 0
    ctx.migrate_group(0, shards - 1)
    assert hw.shard_of_group(0) == shards - 1, hw.group_placement()
    stack, lstate = hw._rows(0)
    last = hw.stacks[shards - 1].rnd
    assert stack.rnd.untyped_storage().data_ptr() == last.untyped_storage().data_ptr()
    waves(3, [0, 1, 2])
    for gid in (0, 1, 2):
        assert [p for _, p in ctx.full_group_log(gid)] == [
            p for _, p in twins[gid].full_group_log(0)
        ]  # fmt: skip


def test_each_shard_keeps_a_slab_of_its_own():
    """Every shard's slab is a ``(Gl, ...)`` allocation of its own on
    ``mesh.devices[s]``; a group's rows are views of its shard's slab; no
    ``(G, ...)`` tensor exists to write to; the gather is a copy in slot
    order, and the unsharded dataplane answers ``_rows`` with views of its
    one slab."""
    g, shards = 8, 4
    mesh = _cpu_mesh(shards)
    sh = T.ShardedMultiGroupDataplane(_cfg(T, g), mesh=mesh, use_kernels=False)
    storages = set()
    for s in range(shards):
        for x in (*vars(sh.stacks[s]).values(), *vars(sh.lstates[s]).values()):
            assert x.device == mesh.devices[s] and x.shape[0] == g // shards
            storages.add(x.untyped_storage().data_ptr())
    assert len(storages) == 6 * shards
    for gid in range(g):
        s, row = divmod(gid, g // shards)
        stack, lstate = sh._rows(gid)
        assert sh.device_of(gid) == mesh.devices[s]
        for view, slab in zip(
            (*vars(stack).values(), *vars(lstate).values()),
            (*vars(sh.stacks[s]).values(), *vars(sh.lstates[s]).values()),
            strict=True,
        ):
            assert view.data_ptr() == slab[row].data_ptr()
    with pytest.raises(AttributeError, match="one slab per shard"):
        sh.stack.rnd[0] = 1
    with pytest.raises(AttributeError, match="one slab per shard"):
        _ = sh.lstate
    with pytest.raises(AttributeError):
        sh.stack = sh.stacks[0]
    sh.pipeline(np.ones((g, 16, V), np.int32), np.ones((g, 16), bool))
    gathered = sh.gather()
    vrnd = gathered["stack.vrnd"]
    assert vrnd.shape == (g, 3, 128) and (vrnd[:, :, :16] == 0).all()
    vrnd[:] = 9
    assert (sh.gather()["stack.vrnd"][:, :, :16] == 0).all()
    mg = T.MultiGroupDataplane(_cfg(T, g), device="cpu")
    stack, lstate = mg._rows(5)
    assert stack.rnd.data_ptr() == mg.stack.rnd[5].data_ptr() and mg.device_of(5) == mg.device
    assert lstate.value.data_ptr() == mg.lstate.value[5].data_ptr()


def test_state_carried_across_into_a_sharded_dataplane():
    """The bridge carries the reference's unsharded state, mid-run with a
    frozen group, a dead acceptor and reclamation on, into a sharded port
    dataplane, whose every shard takes its rows on its own device; the port
    then runs on equal to the reference.  A sharded export, after a
    migration, carries its placement into a fresh sharded dataplane."""
    g, shards = 8, 4
    ref = R.MultiGroupDataplane(_cfg(R, g))
    rng = np.random.default_rng(11)
    ref.enable_reclamation()
    ref.kill_acceptor(6, 0)
    ref.freeze_group(1)
    for gids in ([0, 1, 2, 3, 4, 5, 6, 7], [2, 5], [0, 7]):
        cv = rng.integers(-50, 50, (len(gids), 16, V)).astype(np.int32)
        ref.pipeline_cohort(gids, cv, np.ones((len(gids), 16), bool))
    sh = T.ShardedMultiGroupDataplane(_cfg(T, g), mesh=_cpu_mesh(shards), use_kernels=True)
    import_state(sh, export_state(ref))
    assert sh.stacks[3].rnd.device == sh.mesh.devices[3]
    for r in range(4):
        if r == 2:
            for hw in (ref, sh):
                hw.restore_group(1, hw.next_inst_host[1], 0)
                hw.set_reclaimed(0, hw.next_inst_host[0])
        vals = rng.integers(-50, 50, (g, 16, V)).astype(np.int32)
        act = np.ones((g, 16), bool)
        _same(ref.pipeline(vals, act), sh.pipeline(vals, act))
        gids = [[3], [0, 6], [1, 2, 5], [7]][r]
        cv = rng.integers(-50, 50, (len(gids), 16, V)).astype(np.int32)
        ca = np.ones((len(gids), 16), bool)
        _same(ref.pipeline_cohort(gids, cv, ca), sh.pipeline_cohort(gids, cv, ca))
    want, have = export_state(ref), export_state(sh)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    np.testing.assert_array_equal(have["slot_of"], np.arange(g))
    # a move, then the port's own state into a fresh sharded dataplane
    sh.retire_group(7)
    sh.set_reclaimed(0, sh.next_inst_host[0])
    sh.migrate_group(0, shards - 1)
    moved = export_state(sh)
    fresh = T.ShardedMultiGroupDataplane(_cfg(T, g), mesh=_cpu_mesh(shards), use_kernels=True)
    import_state(fresh, moved)
    assert fresh.placement == sh.placement and fresh.shard_of_group(0) == shards - 1
    vals = rng.integers(-50, 50, (g, 16, V)).astype(np.int32)
    act = np.ones((g, 16), bool)
    _same(sh.pipeline(vals, act), fresh.pipeline(vals, act))
    for key, arr in export_state(sh).items():
        np.testing.assert_array_equal(export_state(fresh)[key], arr, err_msg=key)


# ---------------------------------------------------------------------------
# four cards without a card
# ---------------------------------------------------------------------------
def _basic_index(x: torch.Tensor, idx):
    """Apply the basic part of an index (ints, slices, None, Ellipsis) by
    view operations, as PyTorch's own indexing does; return the view and
    the advanced (tensor) indices, with None on the dims kept whole."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    real = sum(i is not None and i is not Ellipsis for i in idx)
    out, dim, adv = x, 0, []
    for i in idx:
        if i is Ellipsis:
            keep = x.dim() - real
            dim, adv = dim + keep, adv + [None] * keep
        elif i is None:
            out, dim, adv = out.unsqueeze(dim), dim + 1, adv + [None]
        elif isinstance(i, int):
            out = out.select(dim, i)
        elif isinstance(i, slice):
            out = torch.ops.aten.slice.Tensor(out, dim, i.start, i.stop, i.step or 1)
            dim, adv = dim + 1, adv + [None]
        else:
            dim, adv = dim + 1, adv + [torch.as_tensor(i)]
    return out, (adv if any(a is not None for a in adv) else None)


# the Tensor methods whose Python binding a CPU-only build refuses on a CUDA
# tensor, by the ATen operation each stands for
_ATEN = {"__invert__": "bitwise_not"}
_NUMPY = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


def _fake_cards():
    """A ``TorchFunctionMode`` for fake CUDA tensors on a machine with no
    card, logging the devices every operation touches.  A CPU-only build
    refuses Python indexing and ``copy_`` on a CUDA tensor, fake or not, so
    the mode runs them as the ATen operations they stand for; a read-back
    (``numpy()``) gives zeros, since a fake tensor holds no data."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_leaves

    class FakeCards(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.log: list[tuple[str, frozenset]] = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.Tensor.__getitem__:
                view, adv = _basic_index(*args)
                out = view if adv is None else torch.ops.aten.index.Tensor(view, adv)
            elif func is torch.Tensor.__setitem__:
                x, idx, v = args
                view, adv = _basic_index(x, idx)
                v = v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=x.dtype)
                if adv is None:
                    torch.ops.aten.copy_.default(view, v)
                else:
                    torch.ops.aten.index_put_.default(view, adv, v)
                out = None
            elif func is torch.Tensor.copy_:
                out = torch.ops.aten.copy_.default(*args[:2])
            elif getattr(func, "__name__", None) == "numpy":
                out = np.zeros(tuple(args[0].shape), _NUMPY[args[0].dtype])
            else:
                try:
                    out = func(*args, **kwargs)
                except RuntimeError as e:
                    if "not linked" not in str(e):
                        raise
                    name = getattr(func, "__name__", str(func))
                    out = getattr(torch.ops.aten, _ATEN.get(name, name))(*args, **kwargs)
            leaves = tree_leaves((args, kwargs, out))
            devices = {str(t.device) for t in leaves if isinstance(t, torch.Tensor)}
            self.log.append((getattr(func, "__name__", str(func)), frozenset(devices)))
            return out

        def cards(self) -> set[str]:
            """The cards touched since the last call, emptying the log;
            raises if one operation touched two cards."""
            seen = set()
            for name, devices in self.log:
                cuda = {d for d in devices if d.startswith("cuda")}
                assert len(cuda) <= 1, (name, devices)
                seen |= cuda
            self.log.clear()
            return seen

    return FakeCards()


def test_four_cards_without_a_card(monkeypatch):
    """``make_group_mesh()`` over four (fake) cards gives shards on
    ``cuda:0-3``, each slab on its card.  A plain-engine dispatch reaches
    every card and no operation mixes two; a group's vote, its software
    coordinator's batch, a crash and restore of one of its acceptors, a
    takeover and a recovery each touch only the card of its shard."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    g = 8
    cards = [f"cuda:{i}" for i in range(4)]
    log = _fake_cards()
    with FakeTensorMode(allow_non_fake_inputs=True), log:
        mesh = make_group_mesh()
        assert [str(d) for d in mesh.devices] == cards
        ctx = T.PaxosContext(_cfg(T, g), mesh=mesh, use_kernels=False, snapshots=True)
        hw = ctx.hw
        for s, card in enumerate(cards):
            for x in (*vars(hw.stacks[s]).values(), *vars(hw.lstates[s]).values()):
                assert str(x.device) == card
        log.cards()
        hw.pipeline(np.ones((g, 16, V), np.int32), np.ones((g, 16), bool))
        assert log.cards() == set(cards)
        hw.pipeline_cohort([1, 6], np.ones((2, 16, V), np.int32), np.ones((2, 16), bool))
        assert log.cards() == set(cards)  # a shard without members rides pad lanes

        gid, card = 5, cards[2]  # group 5 is row 1 of shard 2
        assert str(hw.device_of(gid)) == card
        co = SoftCoordinator(cid=1, crnd=17, next_inst=32)
        p2a = ctx._soft_p2a(co, np.ones((16, V), np.int32), np.ones(16, bool), gid=gid)
        votes = hw.group_view(gid).vote(p2a)
        assert {str(v.inst.device) for v in votes} == {card}
        assert log.cards() == {card}
        ctx.crash_acceptor(1, group=gid)
        assert log.cards() == {card}
        failover.restore_acceptor(hw, 1, gid=gid)
        assert log.cards() == {card}
        ctx.fail_coordinator(group=gid)
        assert log.cards() == {card}
        ctx.recover(40, group=gid)
        ctx.pump()
        assert log.cards() == {card}
        ctx.snapshot_group(gid)
        assert log.cards() <= {card, cards[0]}  # the seal runs on the home card


def test_a_card_the_mesh_does_not_start_on_is_refused(monkeypatch):
    """A context asked for a card other than its mesh's home refuses it,
    rather than put the slabs on the mesh's cards: ``cuda:1`` on two logical
    shards of the current card, or on the four-card mesh whose home is
    ``cuda:0``.  ``"cuda"`` and the home's own index are taken."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = _cfg(T, 8)
    for mesh in (make_group_mesh(2), make_group_mesh()):
        with pytest.raises(ValueError, match="device cuda:1 is not the mesh's device"):
            T.PaxosContext(cfg, mesh=mesh, device="cuda:1")
        with pytest.raises(ValueError, match="device cuda:1 is not the mesh's device"):
            T.ShardedMultiGroupDataplane(cfg, mesh=mesh, device="cuda:1", use_kernels=False)
    with FakeTensorMode(allow_non_fake_inputs=True), _fake_cards():
        mesh = make_group_mesh()
        for asked in ("cuda", "cuda:0"):
            hw = T.ShardedMultiGroupDataplane(cfg, mesh=mesh, device=asked, use_kernels=False)
            assert [str(st.rnd.device) for st in hw.stacks] == [f"cuda:{i}" for i in range(4)]
