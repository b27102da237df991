"""The port's dry run (``repro_torch.launch.dryrun``) on a fake (16, 16)
process group, in a subprocess.

``lower_cell`` traces the train step of reduced configs of a dense (qwen3-4b),
an MoE (dbrx-132b) and a recurrent (recurrentgemma-2b) family on meta
tensors placed over the production mesh.  Each record is ``ok``; its
``arg_bytes_per_dev_est`` equals the bytes worked out from the reference's
resolved specs on the reference's shapes; its ``flops`` are the port's
analytic terms'; it counted products and collectives.  A ``long_500k`` cell
of a full-attention family is skipped with the reference's reason, and the
CLI writes its record.
"""

from __future__ import annotations

import json
import math
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
from repro_torch.analysis import analytic  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-4b", "dbrx-132b", "recurrentgemma-2b")

CELLS = """
import json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
for arch in %r:
    rec = dryrun.lower_cell(arch, "train_4k", multi_pod=False, cfg=get_config(arch).reduced())
    print("RECORD " + json.dumps(rec))
""" % (ARCHS,)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _reference_arg_bytes(arch: str) -> float:
    """One device's share of the train step's arguments, from the
    reference's specs on its (16, 16) abstract mesh."""
    cfg = jax_config(arch).reduced()
    mesh = jsh.abstract_mesh((16, 16), ("data", "model"))
    specs = jreg.input_specs(cfg, JSHAPES["train_4k"])
    shapes = jax.tree_util.tree_leaves((jtl.state_shapes(cfg), specs))
    axes = jax.tree_util.tree_leaves(
        (jtl.state_axes(cfg), {k: jsh.BATCH_AXES[k] for k in specs}), is_leaf=_is_axes
    )
    total = 0.0
    for sds, ax in zip(shapes, axes, strict=True):
        spec = jsh.resolve_spec(sds.shape, ax, jsh.BASE_RULES, mesh) if ax else ()
        pieces = math.prod(16 for part in spec if part is not None
                           for _ in ((part,) if isinstance(part, str) else part))  # fmt: skip
        total += math.prod(sds.shape) * sds.dtype.itemsize / pieces
    return total


@pytest.fixture(scope="module")
def records() -> dict[str, dict]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", CELLS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)  # fmt: skip
    assert out.returncode == 0, out.stderr[-4000:]
    recs = [json.loads(x[len("RECORD ") :]) for x in out.stdout.splitlines()
            if x.startswith("RECORD ")]  # fmt: skip
    return {r["arch"]: r for r in recs}


@pytest.mark.parametrize("arch", ARCHS)
def test_lower_cell_traces_the_reduced_train_step(records, arch):
    rec = records[arch]
    assert rec.get("ok") is True, rec.get("traceback", rec)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["arg_bytes_per_dev_est"] == _reference_arg_bytes(arch)
    cfg, shape = get_config(arch).reduced(), SHAPES["train_4k"]
    terms = analytic.analytic_terms(cfg, shape, analytic.MeshInfo.for_mesh(False, 256, "base"))
    assert rec["flops"] == terms["flops"] and rec["model_flops"] == terms["model_flops"]
    assert rec["bytes_accessed"] == terms["hbm_bytes"]
    assert rec["flops_counted"] > 0 and rec["collective_bytes"] > 0
    assert rec["collective_counts"].get("all_gather_into_tensor", 0) > 0
    assert rec["roofline"]["arch"] == arch
    assert not {"compile_s", "peak_bytes", "argument_bytes", "temp_bytes"} & set(rec)


def test_long_context_cell_of_a_full_attention_family_is_skipped(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gemma3-27b",
           "--shape", "long_500k", "--mesh", "both", "--out", str(tmp_path)]  # fmt: skip
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: ok=0 skip=2 fail=0" in out.stdout
    rec = json.loads((tmp_path / "gemma3-27b__long_500k__single__base.json").read_text())
    assert rec["skipped"] == (
        "long_500k requires sub-quadratic sequence mixing; "
        "family 'dense' is full-attention (see DESIGN.md §5)"
    )
    assert "ok" not in rec and rec["chips"] == 256
