"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), on shape-only meshes.

For every arch, every rule set and both production meshes, ``resolve_spec``
gives the reference's ``PartitionSpec`` (read as a tuple) on every param,
train-state, cache and batch leaf.  Neither side touches a device: the
reference's ``abstract_mesh`` needs none, the port's is shape-only.  Also:
the eight cases of ``tests/test_sharding_rules.py`` by value, the DTensor
placements of a spec, and the activation-sharder hook of ``models.layers``.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


@functools.cache
def _reference_specs(arch: str, rules: str, mesh: str) -> dict[str, list]:
    """The reference's resolved specs, as tuples, leaf by leaf."""
    cfg = jax_config(arch)
    m = jsh.abstract_mesh(*MESHES[mesh])
    r = {"base": jsh.BASE_RULES, "opt": jsh.OPT_RULES, "notp": jsh.NOTP_RULES,
         "serve": jsh.SERVE_RULES}[rules]  # fmt: skip

    def specs(shapes, axes):
        flat_axes = jax.tree_util.tree_leaves(axes, is_leaf=_is_axes)
        flat_shapes = jax.tree_util.tree_leaves(shapes)
        return [tuple(jsh.resolve_spec(s.shape, a, r, m)) if a else ()
                for s, a in zip(flat_shapes, flat_axes, strict=True)]  # fmt: skip

    decode = jreg.input_specs(cfg, JSHAPES["decode_32k"])
    cache_axes = jreg.family_module(cfg).CACHE_AXES
    batch = [(k, v.shape) for shape in ("train_4k", "prefill_32k", "decode_32k")
             for k, v in sorted(jreg.input_specs(cfg, JSHAPES[shape]).items())
             if k != "cache"]  # fmt: skip
    return {
        "params": specs(jreg.param_shapes(cfg), jreg.param_axes(cfg)),
        "state": specs(jtl.state_shapes(cfg), jtl.state_axes(cfg)),
        "cache": [tuple(jsh.resolve_spec(v.shape, cache_axes[k], r, m))
                  for k, v in sorted(decode["cache"].items())],  # fmt: skip
        "batch": [tuple(jsh.resolve_spec(s, jsh.BATCH_AXES[k], r, m)) for k, s in batch],
    }


def _port_specs(arch: str, rules: str, mesh: str) -> dict[str, list]:
    cfg = get_config(arch)
    m = sh.abstract_mesh(*MESHES[mesh])
    r = sh.RULES[rules]

    def specs(shapes, axes):
        return [s.spec for s in L.tree_leaves(sh.tree_shardings(shapes, axes, r, m))]

    cache = sh.batch_shardings(registry.input_specs(cfg, SHAPES["decode_32k"]), cfg, r, m)
    batch = [sh.batch_shardings(registry.input_specs(cfg, SHAPES[shape]), cfg, r, m)
             for shape in ("train_4k", "prefill_32k", "decode_32k")]  # fmt: skip
    return {
        "params": specs(registry.param_shapes(cfg), registry.param_axes(cfg)),
        "state": specs(train_loop.state_shapes(cfg), train_loop.state_axes(cfg)),
        "cache": [cache["cache"][k].spec for k in sorted(cache["cache"])],
        "batch": [b[k].spec for b in batch for k in sorted(b) if k != "cache"],
    }


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", sorted(sh.RULES))
@pytest.mark.parametrize("arch", list_archs())
def test_resolve_spec_matches_the_reference(arch, rules, mesh):
    ref = _reference_specs(arch, rules, mesh)
    got = _port_specs(arch, rules, mesh)
    for kind in ("params", "state", "cache", "batch"):
        assert len(got[kind]) == len(ref[kind]) > 0, kind
        assert got[kind] == ref[kind], kind


# the eight cases of tests/test_sharding_rules.py, by value: (shape, axes,
# rule set, mesh, expected spec) rows, several for a case with several asserts
RULE_CASES = {
    "param_fsdp_tp": [((4096, 32, 128), ("embed", "heads", "head_dim"), "base", "16x16",
                       ("data", "model"))],
    "kv_heads_fall_back_to_replication_when_indivisible": [
        ((4096, 4, 128), ("embed", "kv_heads", "head_dim"), "base", "16x16", ("data",))],
    "vocab_sharded_when_divisible": [
        ((262144, 5376), ("vocab", "embed"), "base", "16x16", ("model", "data")),
        ((51865, 512), ("vocab", "embed"), "base", "16x16", (None, "data"))],
    "no_axis_reuse": [((2560, 2560), ("embed", "embed"), "base", "16x16", ("data",))],
    "batch_axis_prefers_pod_data": [
        ((256, 4096), ("batch", None), "base", "2x16x16", (("pod", "data"),)),
        ((1, 4096), ("batch", None), "base", "2x16x16", ())],
    "opt_rules_enable_sp_and_cache_seq": [
        ((256, 4096, 5376), ("batch", "act_seq", None), "opt", "2x16x16",
         (("pod", "data"), "model")),
        ((40, 128, 32768, 8, 128), ("layers", "batch", "cache_seq", "kv_heads", None), "opt",
         "2x16x16", (None, ("pod", "data"), "model"))],
    "expert_parallel": [((16, 6144, 10752), ("expert", "embed", "expert_mlp"), "base", "16x16",
                         ("model", "data"))],
    "mesh_construction_contract": [],
}  # fmt: skip

MESH_CONTRACT = """
import torch.distributed as dist
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
for multi, world in ((False, 256), (True, 512)):
    fake_world(world)
    m = make_production_mesh(multi_pod=multi, device="cpu")
    print(tuple(m.shape), tuple(m.mesh_dim_names))
    try:
        make_production_mesh(multi_pod=not multi, device="cpu")
    except ValueError as e:
        print("refused:", e)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_sharding_rule_cases_by_value(case):
    if case == "mesh_construction_contract":
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", MESH_CONTRACT], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)  # fmt: skip
        assert out.returncode == 0, out.stderr[-3000:]
        lines = out.stdout.strip().splitlines()
        assert lines[0] == "(16, 16) ('data', 'model')"
        assert "needs a world of 512 ranks, this one has 256" in lines[1]
        assert lines[2] == "(2, 16, 16) ('pod', 'data', 'model')"
        assert "needs a world of 256 ranks, this one has 512" in lines[3]
        return
    for shape, axes, rules, mesh, want in RULE_CASES[case]:
        got = sh.resolve_spec(shape, axes, sh.RULES[rules], sh.abstract_mesh(*MESHES[mesh]))
        ref = jsh.resolve_spec(shape, axes, jsh.OPT_RULES if rules == "opt" else jsh.BASE_RULES,
                               jsh.abstract_mesh(*MESHES[mesh]))  # fmt: skip
        assert got == want == tuple(ref)


def test_placements_of_pod_data_shard_both_mesh_dims_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    m3 = sh.abstract_mesh(*MESHES["2x16x16"])
    spec = sh.resolve_spec((256, 4096, 5376), ("batch", "act_seq", None), sh.OPT_RULES, m3)
    assert spec == (("pod", "data"), "model")
    assert sh.placements(spec, m3) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements((), m3) == (Replicate(),) * 3
    assert sh.placements((None, "data"), sh.abstract_mesh(*MESHES["16x16"])) == (
        Shard(1), Replicate())  # fmt: skip
    s = sh.sharding(m3, spec)
    assert s.shard_factor() == 2 * 16 * 16 and s.placements == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="axis order"):
        sh.placements((("data", "pod"),), m3)


def test_use_rules_installs_the_sharder_and_uninstalls_it_on_exit():
    m = sh.abstract_mesh(*MESHES["16x16"])
    assert L._ACTIVATION_SHARDER is None
    with sh.use_rules(m, sh.OPT_RULES):
        assert L._ACTIVATION_SHARDER is not None
        x = torch.ones(4, 8)
        assert L.shard(x, ("batch", None)) is x  # a plain tensor is left as it is
    assert L._ACTIVATION_SHARDER is None
    with pytest.raises(RuntimeError, match="inside"):
        with sh.use_rules(m):
            raise RuntimeError("inside")
    assert L._ACTIVATION_SHARDER is None


@pytest.mark.parametrize(
    "mesh, rules, axes",
    [("16x16", "base", ("data",)), ("2x16x16", "base", ("pod", "data")),
     ("2x16x16", "serve", ("pod", "data")), ("2x16x16", "notp", ("pod", "data"))],
)  # fmt: skip
def test_use_rules_hands_layers_the_axes_the_batch_splits_over(mesh, rules, axes):
    """``layer`` gathers a param's splits over the mesh axes that the rules
    split the batch over (FSDP), which ``install`` takes from the rules;
    with nothing installed it gathers none."""
    m = sh.abstract_mesh(*MESHES[mesh])
    assert sh.fsdp_axes(sh.RULES[rules], m) == axes
    with sh.use_rules(m, sh.RULES[rules]):
        assert L._FSDP_AXES == axes
    assert L._FSDP_AXES == ()


def test_shard_is_the_identity_without_a_sharder():
    assert L._ACTIVATION_SHARDER is None
    x = torch.arange(6.0).reshape(2, 3)
    assert L.shard(x, ("batch", "act_seq")) is x
    seen = []
    L.set_activation_sharder(lambda t, axes: seen.append(axes) or t * 2)
    try:
        assert torch.equal(L.shard(x, ("batch", None)), x * 2) and seen == [("batch", None)]
    finally:
        L.set_activation_sharder(None)
    assert L.shard(x, ("batch", None)) is x
