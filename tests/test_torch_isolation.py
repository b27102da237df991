"""The port stands alone: no module of ``repro_torch``, nor ``chip_smoke``,
nor the port's examples (``examples/torch_*.py``, the training and
serving examples too), imports ``jax`` or the reference package ``repro``; and the consensus
service and KV tier do not load the models.

Checked in a fresh interpreter, because this test process has both loaded.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import importlib.util
from pathlib import Path
examples = sorted(Path("examples").glob("torch_*.py"))
for path in examples:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), [p.name for p in examples], leaked)
assert len(examples) == 5, examples
assert not leaked, leaked
for name in ("kernels.wirepath", "core.api", "core.fabric", "launch", "launch.mesh",
             "kernels.flash_attention", "models.transformer", "serve.engine", "configs",
             "launch.serve", "serve.service", "serve.kv", "core.log", "core.baseline",
             "train.elastic", "train.optimizer", "train.data", "train.train_loop",
             "train.checkpoint", "launch.train", "models.convert"):
    assert "repro_torch." + name in names, names
"""

TIER = """
import sys
import repro_torch.serve.kv
from repro_torch.serve import ConsensusService, ReplicatedKV, session_hash
import repro_torch.core.log, repro_torch.core.baseline, repro_torch.train.elastic
heavy = ("repro_torch.models", "repro_torch.serve.engine")
loaded = sorted(m for m in sys.modules if m.startswith(heavy))
print(loaded)
assert not loaded, loaded
import repro_torch.serve as serve
assert serve.ServeLoop.__module__ == "repro_torch.serve.engine"
assert "repro_torch.models" in sys.modules
"""


def _probe(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.strip()


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    assert _probe(PROBE).endswith("[]")


def test_service_and_kv_tier_do_not_load_the_models():
    assert _probe(TIER) == "[]"
