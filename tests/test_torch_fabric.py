"""The port's acceptor-sharded fabric consensus and quorum step-commit on
eight CPU processes over gloo, bit for bit against the reference's on eight
forced host devices.

One JAX subprocess (``--xla_force_host_platform_device_count=8``) runs the
reference's ``make_fabric_consensus`` and ``quorum_commit_digest`` under
``shard_map``; one eight-rank gloo run a mesh runs the port's on the same
numpy inputs, made from a seed.  Two meshes: ``(8,)`` over ``("acc",)``,
and ``(4, 2)`` from each package's ``make_host_mesh(8, model_parallel=2)``
with ``axis="data"`` (so each acceptor is held by the two ranks of its
``model`` row).

The schedule: 8 rounds at N = 64, 4 proposals a rank, V = 4, so the ring
laps (4 times on 8 acceptors, twice on 4); random ``active`` masks; every
acceptor alive, a bare quorum alive, one fewer (no decision), random
liveness; ``crnd`` 2, then 1 (every vote rejected: the slots promised round
2), then 3.  After every round ``decided``, ``inst``, ``value``, the
coordinator state and every acceptor's whole register file (the dead
ones' too) must equal the reference's on every rank.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

N, V, B_LOCAL, ROUNDS = 64, 4, 4, 8
CRND = [2, 2, 2, 2, 1, 1, 3, 3]  # rounds 4 and 5 come back to slots promised round 2
MESHES = {  # name -> (acceptors on the axis, axis, quorum given, quorum in force)
    "acc8": (8, "acc", 5, 5),
    "data4x2": (4, "data", None, 3),
}
REGISTERS = ("rnd", "vrnd", "value")
ROUND_OUT = ("decided", "inst", "out_value", "next_inst", "crnd")

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import functools, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.fabric import _shard_map, make_fabric_consensus, quorum_commit_digest
from repro.core.types import CoordinatorState
from repro.launch.mesh import make_host_mesh

run = json.load(open("case.json"))
for name, (n_acc, axis, quorum, q) in run["meshes"].items():
    inp = np.load(f"{name}.npz")
    mesh = jax.make_mesh((8,), ("acc",)) if name == "acc8" else make_host_mesh(8, model_parallel=2)
    init_fn, step = make_fabric_consensus(mesh, axis=axis, quorum=quorum, n_instances=run["n"],
                                          value_words=run["v"])
    astate, cstate = init_fn()
    rec = {k: [] for k in run["keys"]}
    for r in range(len(inp["crnd"])):
        cstate = CoordinatorState(next_inst=cstate.next_inst, crnd=jnp.int32(inp["crnd"][r]))
        astate, cstate, decided, inst, value = step(astate, cstate, inp["values"][r],
                                                    inp["active"][r], inp["alive"][r])
        for k, x in zip(run["keys"], (decided, inst, value, cstate.next_inst, cstate.crnd,
                                      astate.rnd, astate.vrnd, astate.value)):
            rec[k].append(np.asarray(x))
    commit = jax.jit(_shard_map(functools.partial(quorum_commit_digest, axis=axis, quorum=q),
                                mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=(P(), P())))
    out = []
    for d, h, scalar in zip(inp["digests"], inp["healthy"], inp["scalar"]):
        c, w = commit(jnp.asarray(d[:, 0] if scalar else d), jnp.asarray(h))
        out.append((bool(c), int(w)))
    np.savez(f"ref_{name}.npz", commit=np.array(out, np.int32), **rec)
print("REFERENCE_OK")
"""

PORT = """
import json, sys
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core.fabric import make_fabric_consensus, quorum_commit_digest
from repro_torch.core.types import CoordinatorState
from repro_torch.launch.mesh import make_host_mesh

def body(rank, name):
    run = json.load(open("case.json"))
    n_acc, axis, quorum, q = run["meshes"][name]
    inp = np.load(f"{name}.npz")
    if name == "acc8":
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("acc",))
    else:
        mesh = make_host_mesh(8, model_parallel=2, device="cpu")
    init_fn, step = make_fabric_consensus(mesh, axis=axis, quorum=quorum, n_instances=run["n"],
                                          value_words=run["v"])
    astate, cstate = init_fn()
    rec = {k: [] for k in run["keys"]}
    t = torch.from_numpy
    storage = [x.to_local().data_ptr() for x in vars(astate).values()]
    for r in range(len(inp["crnd"])):
        crnd = torch.tensor(int(inp["crnd"][r]), dtype=torch.int32)
        cstate = CoordinatorState(cstate.next_inst, crnd)
        astate, cstate, decided, inst, value = step(astate, cstate, t(inp["values"][r]),
                                                    t(inp["active"][r]), t(inp["alive"][r]))
        outs = (decided, inst, value, cstate.next_inst, cstate.crnd)
        regs = (astate.rnd, astate.vrnd, astate.value)
        local = [x.to_local() for x in outs] + [x.full_tensor() for x in regs]
        for k, x in zip(run["keys"], local):
            rec[k].append(x.numpy().copy())
    b = (run["n"] // n_acc + 1) * n_acc  # one round past the ring
    try:
        step(astate, cstate, torch.zeros((b, run["v"]), dtype=torch.int32),
             torch.ones(b, dtype=torch.bool), torch.ones(n_acc, dtype=torch.bool))
        raised = ""
    except ValueError as e:
        raised = str(e)
    in_place = storage == [x.to_local().data_ptr() for x in vars(astate).values()]
    plain = type(astate)(*(x.to_local() for x in vars(astate).values()))
    try:
        step(plain, cstate, t(inp["values"][0]), t(inp["active"][0]), t(inp["alive"][0]))
        refused = ""
    except TypeError as e:
        refused = str(e)
    me = mesh.get_local_rank(axis)
    out = []
    for d, h, scalar in zip(inp["digests"], inp["healthy"], inp["scalar"]):
        digest = torch.as_tensor(d[me, 0] if scalar else d[me])
        c, w = quorum_commit_digest(digest, torch.as_tensor(h[me]), axis=axis, quorum=q,
                                    mesh=mesh)
        out.append((bool(c), int(w)))
    np.savez(f"port_{name}_{rank}.npz", commit=np.array(out, np.int32), raised=raised,
             in_place=in_place, refused=refused, **rec)

def run_rank(rank, world, store, name):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        body(rank, name)
    finally:
        dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run_rank, args=(8, sys.argv[1], sys.argv[2]), nprocs=8)
"""


def _schedule(n_acc: int, q: int, seed: int) -> dict[str, np.ndarray]:
    """Every round's proposals, ``active`` and ``alive``, and the digest
    cases, for ``n_acc`` acceptors under quorum ``q``."""
    rng = np.random.default_rng(seed)
    b = B_LOCAL * n_acc
    full = np.ones(n_acc, bool)
    bare = np.arange(n_acc) < q  # the last n_acc - q dead
    alive = [full, bare, np.arange(n_acc) < q - 1, rng.random(n_acc) < 0.6, full, bare[::-1],
             full, rng.random(n_acc) < 0.6]  # fmt: skip
    digests, healthy, scalar = [], [], []
    for k in (1, 4):  # a [] digest (the first of 4 words) or a [4] one
        same = np.zeros((n_acc, 4), np.int64)
        same[:, :k] = rng.integers(-(2**31), 2**31, k)
        corrupt = same.copy()
        corrupt[0, k - 1] ^= 1
        halves = np.where(np.arange(n_acc)[:, None] < n_acc // 2, same, same ^ 7)
        stragglers = np.arange(n_acc) < q  # the rest abstain
        for d, h in (
            (same, full),
            (same, stragglers),
            (same, np.arange(n_acc) < q - 1),
            (same, ~full),
            (corrupt, full),
            (corrupt, stragglers),  # the corrupt rank among q healthy: q - 1 agree
            (halves, full),
        ):
            digests.append(np.asarray(d, np.int32))
            healthy.append(h)
            scalar.append(k == 1)
    return {
        "values": rng.integers(-(2**31), 2**31, (ROUNDS, b, V)).astype(np.int32),
        "active": rng.random((ROUNDS, b)) < 0.75,
        "alive": np.stack(alive),
        "crnd": np.array(CRND, np.int32),
        "digests": np.stack(digests),
        "healthy": np.stack(healthy),
        "scalar": np.array(scalar),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The inputs, the reference's outputs and every rank's of the port, by
    mesh: the JAX subprocess runs beside the two gloo runs."""
    d = tmp_path_factory.mktemp("fabric")
    keys = list(ROUND_OUT + REGISTERS)
    (d / "case.json").write_text(json.dumps({"meshes": MESHES, "n": N, "v": V, "keys": keys}))
    inputs = {}
    for i, (name, (n_acc, _axis, _given, q)) in enumerate(MESHES.items()):
        inputs[name] = _schedule(n_acc, q, seed=35 + i)
        np.savez(d / f"{name}.npz", **inputs[name])
    (d / "ref.py").write_text(REFERENCE)
    (d / "port.py").write_text(PORT)
    ref_env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "ref.py"], cwd=d, env=ref_env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)  # fmt: skip
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        for name in MESHES:
            cmd = [sys.executable, "port.py", str(d / f"store_{name}"), name]
            out = subprocess.run(cmd, cwd=d, env=env, capture_output=True, text=True, timeout=300)
            assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
        stdout, stderr = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0 and "REFERENCE_OK" in stdout, stderr[-4000:]
    return {
        name: {
            "inputs": inputs[name],
            "ref": dict(np.load(d / f"ref_{name}.npz")),
            "port": [dict(np.load(d / f"port_{name}_{r}.npz")) for r in range(8)],
        }
        for name in MESHES
    }


@pytest.mark.parametrize("name", list(MESHES))
def test_fabric_rounds_equal_the_reference_on_every_rank(runs, name):
    """Every round's ``decided``, ``inst``, ``value`` and coordinator state
    on every rank, and the whole register file of every acceptor, equal
    the reference's bit for bit."""
    run = runs[name]
    ref = run["ref"]
    for rank, got in enumerate(run["port"]):
        for key in ROUND_OUT + REGISTERS:
            for r in range(ROUNDS):
                want = ref[key][r]
                assert got[key][r].dtype == want.dtype, (key, got[key][r].dtype, want.dtype)
                what = f"{key} rank {rank} round {r}"
                np.testing.assert_array_equal(got[key][r], want, err_msg=what)


@pytest.mark.parametrize("name", list(MESHES))
def test_the_schedule_decides_rejects_and_laps(runs, name):
    """The schedule reaches what it is for: a bare quorum decides every
    active and inactive proposal, one fewer decides nothing, the rounds at
    ``crnd`` 1 are rejected on slots promised round 2, and the rounds at
    ``crnd`` 3 decide again past the ring's end."""
    n_acc, _axis, _given, q = MESHES[name]
    ref = runs[name]["ref"]
    assert ref["decided"][[0, 1, 6]].all()
    assert not ref["decided"][[2, 4, 5]].any()
    assert ref["inst"][-1][-1] == ROUNDS * B_LOCAL * n_acc - 1 > N
    assert (ref["rnd"][3] == 2).all() and (ref["rnd"][7] == 3).any()


@pytest.mark.parametrize("name", list(MESHES))
def test_a_dead_acceptor_takes_the_vote(runs, name):
    """As the reference's code does (not its comment): a dead acceptor's
    registers take the round's vote; only its agree bit is left out."""
    n_acc, _axis, _given, q = MESHES[name]
    run = runs[name]
    dead = n_acc - 1  # dead in round 1
    assert not run["inputs"]["alive"][1][dead]
    slots = np.arange(B_LOCAL * n_acc, 2 * B_LOCAL * n_acc) % N
    for regs in (run["ref"], run["port"][0]):
        assert (regs["vrnd"][0][dead, slots] == -1).all()
        assert (regs["vrnd"][1][dead, slots] == CRND[1]).all()


@pytest.mark.parametrize("name", list(MESHES))
def test_quorum_commit_digest_equals_the_reference_on_every_rank(runs, name):
    """``(commit, win)`` over scalar and 4-word digests: every rank
    healthy, a bare quorum, one fewer, none; a corrupt rank among all and
    among a bare quorum; two digests held by half the ranks each."""
    n_acc, _axis, _given, q = MESHES[name]
    ref = runs[name]["ref"]["commit"]
    for rank, got in enumerate(runs[name]["port"]):
        np.testing.assert_array_equal(got["commit"], ref, err_msg=f"rank {rank}")
    want_win = [n_acc, q, q - 1, 0, n_acc - 1, q - 1, n_acc // 2] * 2
    assert ref[:, 1].tolist() == want_win
    assert ref[:, 0].tolist() == [w >= q for w in want_win]


@pytest.mark.parametrize("name", list(MESHES))
def test_a_round_past_the_ring_raises_on_every_rank(runs, name):
    """A round of more proposals than ring slots raises ``ValueError`` on
    every rank of the CPU route, before any collective."""
    for got in runs[name]["port"]:
        assert "B must not exceed N" in str(got["raised"]), got["raised"]


@pytest.mark.parametrize("name", list(MESHES))
def test_the_registers_are_updated_in_place_and_plain_ones_refused(runs, name):
    """Every round votes into the local shards of ``init_fn``'s register
    DTensors, so those of the last round share their storage (the state
    from before a round does not survive it, unlike the reference's); a
    plain-tensor register file raises ``TypeError`` on every rank, before
    any collective."""
    for got in runs[name]["port"]:
        assert bool(got["in_place"])
        assert "init_fn's DTensors" in str(got["refused"]), got["refused"]
