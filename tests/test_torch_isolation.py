"""The port stands alone: no module of ``repro_torch``, nor ``chip_smoke``,
imports ``jax`` or the reference package ``repro``.

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
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
assert not leaked, leaked
for name in ("kernels.wirepath", "core.api", "core.fabric", "launch", "launch.mesh",
             "kernels.flash_attention", "models.transformer", "serve.engine", "configs",
             "launch.serve"):
    assert "repro_torch." + name in names, names
"""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")
