"""The port's consensus-committed checkpoints, after
``tests/test_checkpoint_failover.py``'s checkpoint cases, on the CPU.

Reduced qwen3-4b train states (whisper is not ported: the uncommitted case
uses qwen3-4b too).  A float32 checkpoint written by either package restores
in the other, leaf for leaf, and both write the same manifest for the same
state; a bfloat16 leaf round-trips through its ``uint16`` form.  Everything
restored is compared bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PaxosConfig, PaxosContext  # noqa: E402
from repro_torch.models.convert import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.train import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticStream  # noqa: E402

CFG = PaxosConfig(n_acceptors=3, n_instances=512, batch=16)
CPU = torch.device("cpu")


def _state(seed: int = 0, dtype: str = "float32"):
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), dtype=dtype)
    return cfg, train_loop.init_state(cfg, torch.Generator().manual_seed(seed))


def _equal(a, b) -> None:
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_roundtrip_committed(tmp_path):
    _, state = _state()
    ctx = PaxosContext(CFG, device=CPU)
    mgr = ckpt_mod.CheckpointManager(str(tmp_path), paxos_ctx=ctx)
    path = mgr.save(state, step=3)
    assert os.path.exists(os.path.join(path, "COMMITTED"))
    # the commit record went through consensus
    records = [p for _, p in ctx.delivered_log if p.startswith(b"ckpt:3:")]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert records == [f"ckpt:3:{manifest['digest']}".encode()]
    assert mgr.latest_committed() == path

    restored, step = mgr.restore(state)
    assert step == 3
    _equal(restored, state)
    assert isinstance(restored, train_loop.TrainState)


def test_uncommitted_checkpoint_invisible(tmp_path):
    """If the consensus layer cannot decide (no quorum), the checkpoint must
    not become eligible for restart."""
    _, state = _state()
    ctx = PaxosContext(CFG, device=CPU)
    ctx.hw.kill_acceptor(0)
    ctx.hw.kill_acceptor(1)  # no quorum
    mgr = ckpt_mod.CheckpointManager(str(tmp_path), paxos_ctx=ctx)
    mgr.save(state, step=1)
    assert os.path.exists(os.path.join(tmp_path, "step_00000001", "manifest.json"))
    assert mgr.latest_committed() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)


def test_restart_resumes_training(tmp_path):
    """Crash/restart: restore from the latest committed step and keep
    training deterministically (the counter-based stream is restart-safe)."""
    cfg, state = _state()
    step = train_loop.make_train_step(cfg)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=16, seed=1))

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in stream.batch_at(i).items()}

    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    for i in range(4):
        state, _ = step(state, batch(i))
    mgr.save(state, step=4)

    # "crash"; restore into a state drawn from another seed and continue
    state2, at = mgr.restore(_state(seed=9)[1])
    assert at == 4
    s_a, m_a = step(state, batch(at))
    s_b, m_b = step(state2, batch(at))
    assert float(m_a["loss"]) == float(m_b["loss"]) and int(m_a["digest"]) == int(m_b["digest"])
    _equal(s_a, s_b)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A float32 checkpoint written by the reference restores in the port,
    and the port writes the same manifest (digest included) for the same
    state."""
    jcfg = jax_config("qwen3-4b").reduced()
    jstate = jtl.init_state(jcfg, jax.random.PRNGKey(0))
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(jstate, step=5)
    _, like = _state(seed=9)
    restored, step = ckpt_mod.CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert step == 5
    want = jax.tree_util.tree_leaves(jstate)
    for got, w in zip(tree_leaves(restored), want, strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert str(got.dtype)[6:] == str(w.dtype)

    ported = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), CPU)
    ckpt_mod.CheckpointManager(str(tmp_path / "port")).save(ported, step=5)
    manifests = [json.loads((tmp_path / side / "step_00000005" / "manifest.json").read_text())
                 for side in ("ref", "port")]  # fmt: skip
    assert manifests[0] == manifests[1]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, state = _state(seed=2)
    batch = SyntheticStream(DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=8)).batch_at(0)
    state, _ = train_loop.make_train_step(cfg)(state, {k: torch.from_numpy(v) for k, v in
                                                       batch.items()})  # fmt: skip
    ckpt_mod.CheckpointManager(str(tmp_path)).save(state, step=1)
    jcfg = jax_config("qwen3-4b").reduced()
    like = jtl.init_state(jcfg, jax.random.PRNGKey(1))
    restored, step = jckpt.CheckpointManager(str(tmp_path)).restore(like)
    assert step == 1
    assert isinstance(restored, jtl.TrainState)
    for got, want in zip(jax.tree_util.tree_leaves(restored), tree_leaves(state), strict=True):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_bf16_leaves_round_trip_through_uint16(tmp_path):
    """bfloat16 params are stored as their raw bits in ``uint16`` arrays
    with ``"bfloat16"`` in the manifest, and come back bit for bit; the
    manifest's digest reads the same bytes as the reference's does."""
    _, state = _state(dtype="bfloat16")
    mgr = ckpt_mod.CheckpointManager(str(tmp_path / "port"))
    path = mgr.save(state, step=2)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = tree_leaves(state)
    for meta, leaf in zip(manifest["leaves"], leaves, strict=True):
        arr = np.load(os.path.join(path, meta["file"]))
        if leaf.dtype == torch.bfloat16:
            assert meta["dtype"] == "bfloat16" and arr.dtype == np.uint16
            np.testing.assert_array_equal(arr, leaf.view(torch.int16).numpy().view(np.uint16))
        else:
            assert meta["dtype"] == str(arr.dtype)
    assert any(meta["dtype"] == "bfloat16" for meta in manifest["leaves"])
    restored, _ = mgr.restore(state)
    _equal(restored, state)

    # the reference (with ml_dtypes) saves the same values: the same digest
    widened = state_to_numpy(state)
    jstate = widened._replace(
        params=jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), widened.params)
    )
    jpath = jckpt.CheckpointManager(str(tmp_path / "ref")).save(jstate, step=2)
    with open(os.path.join(jpath, "manifest.json")) as f:
        assert json.load(f)["digest"] == manifest["digest"]


def test_restore_onto_other_shardings_raises(tmp_path):
    _, state = _state()
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(state, step=1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 9"):
        mgr.restore(state, shardings=object())
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(state.params)
