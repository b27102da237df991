"""The port's meshed training, digest, save and restore on eight CPU
processes over gloo.

Each test runs a script in a subprocess (the test process keeps no process
group), which spawns eight ranks joined through a file store; rank 0 prints
the results as JSON.

* Two train steps of a reduced qwen3-4b on a ``(data, model)`` mesh from
  ``launch.mesh.make_host_mesh``: each step's loss and grad norm within
  1e-3 relative of the port's unmeshed steps and of the reference's jitted
  steps from the same params, and every rank's gradient digest equal.  Two
  cases in which the key heads cannot take the ``model`` axis while the
  query heads take it: on (4, 2) ``n_kv_heads`` cut to 1, so each rank's
  two query heads meet the one key head; on (2, 4) 12 query heads and 3 key
  heads, so a rank's query heads straddle a group's edge.
* The gradient digest of a tree of DTensors, taken shard by shard, equals
  the digest of its gathered leaves and of the plain tree, and its
  checkpoint, sent to rank 0 shard by shard, equals the plain tree's.
* A reduced dbrx-132b forward on a (2, 4) mesh, its 4 experts 4-way (expert
  parallel), within 5e-4 of the unmeshed forward, as the reference's
  ``test_sharded_moe_expert_parallel`` asks; then a meshed state saved and
  restored with ``shardings=``: every leaf equal, with its resolved
  placements.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch.models.convert import state_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

HEAD = """
import json, os, sys, dataclasses
import torch, torch.distributed as dist, torch.multiprocessing as mp

def run(rank, world, store, body):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        out = body(rank)
        if rank == 0:
            print("RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
"""

TAIL = """
if __name__ == "__main__":
    mp.spawn(run, args=(8, sys.argv[1], body), nprocs=8)
"""


def _gloo(tmp_path: Path, body: str) -> dict:
    script = tmp_path / "ranks.py"
    script.write_text(HEAD + body + TAIL)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "store")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)  # fmt: skip
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT ") :])


OPT = {"lr": 1e-2, "warmup_steps": 0, "total_steps": 10}  # a second loss the update moves

TRAIN = """
from repro_torch.configs import get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import train_loop
from repro_torch.train.optimizer import OptConfig

def steps(state, batch, step):
    out = []
    for _ in range(2):
        state, m = step(state, batch)
        digests = [None] * 8
        dist.all_gather_object(digests, int(m["digest"]))
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "digests": digests})
    return out

def body(rank):
    case = json.load(open("case.json"))
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), **case["cfg"])
    step = train_loop.make_train_step(cfg, OptConfig(**case["opt"]))
    state, batch = torch.load("inputs.pt", weights_only=False)
    plain = steps(state, dict(batch), step)
    state, batch = torch.load("inputs.pt", weights_only=False)
    mesh = make_host_mesh(8, model_parallel=case["mp"], device="cpu")
    rules = sh.BASE_RULES
    ssh = sh.tree_shardings(train_loop.state_shapes(cfg), train_loop.state_axes(cfg), rules, mesh)
    bsh = sh.batch_shardings(batch, cfg, rules, mesh)
    with sh.use_rules(mesh, rules):
        state = sh.place_tree(state, ssh)
        meshed = steps(state, {k: bsh[k].place(v) for k, v in batch.items()}, step)
    heads = ssh.params["blocks"]["attn"]
    return {"plain": plain, "meshed": meshed, "mesh": list(mesh.shape),
            "wq": list(heads["wq"].spec), "wk": list(heads["wk"].spec), "calls": sh.calls}
"""


def _train_case(tmp_path: Path, cfg: dict, mp: int) -> tuple[dict, list[dict]]:
    """Two steps of a reduced qwen3-4b with ``cfg`` over it: unmeshed and on
    a ``(8 // mp, mp)`` mesh on eight ranks (``TRAIN``), and the
    reference's jitted steps from the same params and batch."""
    jcfg = dataclasses.replace(jax_config("qwen3-4b").reduced(), **cfg)
    jstate = jtl.init_state(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (8, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), torch.device("cpu"))
    torch.save((state, {k: torch.from_numpy(v) for k, v in batch.items()}), tmp_path / "inputs.pt")
    (tmp_path / "case.json").write_text(json.dumps({"cfg": cfg, "mp": mp, "opt": OPT}))
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt.OptConfig(**OPT)))
    ref = []
    for _ in range(2):
        jstate, jm = jstep(jstate, batch)
        ref.append({"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"])})
    return _gloo(tmp_path, TRAIN), ref


def _assert_steps_agree(got: dict, ref: list[dict]) -> None:
    """Both steps' loss and grad norm within 1e-3 relative, meshed against
    unmeshed and against the reference: the first loss reads the forward
    only, its grad norm the backward and the gradient reduction, the second
    loss the optimizer update as well.  Every rank's digest equal."""
    for plain, meshed, jm in zip(got["plain"], got["meshed"], ref, strict=True):
        for key in ("loss", "grad_norm"):
            assert abs(meshed[key] - plain[key]) <= 1e-3 * abs(plain[key]), (key, meshed, plain)
            assert abs(meshed[key] - jm[key]) <= 1e-3 * abs(jm[key]), (key, meshed, jm)
        assert len(set(meshed["digests"])) == 1, meshed["digests"]
    assert got["plain"][1]["loss"] != got["plain"][0]["loss"]
    assert got["calls"] > 0


def test_meshed_train_step_matches_the_unmeshed_and_the_reference(tmp_path):
    got, ref = _train_case(tmp_path, {"n_kv_heads": 1}, mp=2)
    assert got["mesh"] == [4, 2]
    # the query heads take the model axis, the one key head cannot
    assert got["wq"] == [None, "data", "model"] and got["wk"] == [None, "data"]
    _assert_steps_agree(got, ref)


def test_meshed_train_step_with_query_heads_straddling_a_group(tmp_path):
    """12 query heads 4-way over ``model`` and 3 key heads, which cannot take
    it: a rank's three query heads straddle a group's edge (rank 1 holds
    heads 3-5, of groups 0 and 1), so each meets its own key head."""
    got, ref = _train_case(tmp_path, {"n_heads": 12, "n_kv_heads": 3}, mp=4)
    assert got["mesh"] == [2, 4]
    assert got["wq"] == [None, "data", "model"] and got["wk"] == [None, "data"]
    _assert_steps_agree(got, ref)


DIGEST = """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch.models import layers as L
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.train_loop import _grad_digest

def body(rank):
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(8, 6, 4, generator=gen),
            "b": torch.randn(4, 10, generator=gen).bfloat16(),
            "c": torch.randn(6, generator=gen), "d": torch.tensor(3, dtype=torch.int32)}
    places = {"a": [Shard(0), Shard(0), Shard(2)], "b": [Replicate(), Shard(0), Shard(1)],
              "c": [Replicate(), Replicate(), Replicate()], "d": [Replicate()] * 3}
    meshed = {k: distribute_tensor(v, mesh, places[k]) for k, v in tree.items()}
    # a partial sum: each rank holds an eighth of ``c``, which adds up exactly
    meshed["e"] = DTensor.from_local(tree["c"] / 8, mesh, [Partial()] * 3, run_check=False)
    tree["e"] = tree["c"]
    path = ckpt_mod.CheckpointManager("ckpt").save(meshed, step=1)
    same = None
    if rank == 0:
        ckpt_mod.CheckpointManager("plain").save(tree, step=1)
        names = sorted(os.listdir(path))
        same = names == sorted(os.listdir(path.replace("ckpt", "plain"))) and all(
            open(os.path.join(path, n), "rb").read()
            == open(os.path.join(path.replace("ckpt", "plain"), n), "rb").read() for n in names)
    return {"meshed": int(_grad_digest(meshed)), "plain": int(_grad_digest(tree)),
            "whole": int(_grad_digest(L.tree_map(L.whole, meshed))), "files_same": same}
"""


def test_meshed_digest_and_save_read_no_whole_leaf(tmp_path):
    """The digest of a meshed tree, summed shard by shard at global indices
    (split pod-major on one dim, split on two, replicated, partial, 16-bit,
    0-d), equals the digest of its gathered leaves and of the plain tree,
    bit for bit; its checkpoint, sent shard by shard to rank 0, is the plain
    tree's, byte for byte."""
    got = _gloo(tmp_path, DIGEST)
    assert got["meshed"] == got["whole"] == got["plain"], got
    assert got["files_same"], got


MOE = """
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import train_loop

def body(rank):
    cfg = get_config("dbrx-132b").reduced()
    mesh = make_host_mesh(8, model_parallel=4, device="cpu")
    rules = sh.BASE_RULES
    gen = torch.Generator().manual_seed(0)
    state = train_loop.init_state(cfg, gen)
    tokens = registry.make_inputs(cfg, ShapeConfig("t", 16, 4, "train"), gen)["tokens"]
    mod = registry.family_module(cfg)
    with torch.no_grad():
        ref, _ = mod.forward(cfg, state.params, {"tokens": tokens})
    ssh = sh.tree_shardings(train_loop.state_shapes(cfg), train_loop.state_axes(cfg), rules, mesh)
    tsh = sh.sharding(mesh, sh.resolve_spec(tokens.shape, sh.BATCH_AXES["tokens"], rules, mesh))
    placed = sh.place_tree(state, ssh)
    with sh.use_rules(mesh, rules), torch.no_grad():
        got, _ = mod.forward(cfg, placed.params, {"tokens": tsh.place(tokens)})
    err = float((got.full_tensor() - ref).abs().max())

    mgr = ckpt_mod.CheckpointManager("ckpt")
    mgr.save(placed, step=7)
    back, step = mgr.restore(train_loop.state_shapes(cfg), shardings=ssh)
    equal = all(torch.equal(b.full_tensor(), a)
                for a, b in zip(L.tree_leaves(state), L.tree_leaves(back)))
    placements = all(tuple(b.placements) == s.placements
                     for b, s in zip(L.tree_leaves(back), L.tree_leaves(ssh)))
    expert = ssh.params["blocks"]["moe"]["wi"]
    return {"err": err, "step": step, "equal": equal, "placements": placements,
            "wi": [str(p) for p in expert.placements], "files": len(os.listdir("ckpt"))}
"""


def test_expert_parallel_forward_and_restore_onto_shardings(tmp_path):
    got = _gloo(tmp_path, MOE)
    # experts (dim 1, after the layers) 4-way over the model axis, embed 2-way over data
    assert got["wi"] == ["S(2)", "S(1)"]
    assert got["err"] < 5e-4, got["err"]
    assert got["step"] == 7 and got["files"] == 1
    assert got["equal"] and got["placements"]
