"""The port's packages re-export the names the reference's do: each name
resolves on the package and is its submodule's own object.  The models'
names load on first use, so importing the package loads no family."""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

NAMES = {
    "core": ("plan", ("Cohort", "DispatchPlanner", "RoundPlan")),
    "launch": ("mesh", ("make_host_mesh", "make_production_mesh")),
    "models": (
        "registry",
        (
            "count_params",
            "family_module",
            "init_params",
            "input_specs",
            "make_inputs",
            "model_specs",
            "param_axes",
            "param_shapes",
        ),
    ),
}


@pytest.mark.parametrize("package", sorted(NAMES))
def test_package_names_are_the_submodules_objects(package):
    pkg = importlib.import_module(f"repro_torch.{package}")
    sub_name, names = NAMES[package]
    sub = importlib.import_module(f"repro_torch.{package}.{sub_name}")
    for name in names:
        assert getattr(pkg, name) is getattr(sub, name), name
    if package == "models":
        assert pkg.registry is sub
        with pytest.raises(AttributeError, match="no attribute 'nothing'"):
            _ = pkg.nothing
    ref = importlib.import_module(f"repro.{package}")
    assert all(hasattr(ref, name) for name in names)


def test_models_package_loads_no_family_until_asked():
    code = (
        "import sys, repro_torch.models as m\n"
        "assert 'repro_torch.models.registry' not in sys.modules\n"
        "assert 'repro_torch.models.transformer' not in sys.modules\n"
        "m.init_params\n"
        "assert 'repro_torch.models.transformer' in sys.modules\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True,
    )  # fmt: skip
    assert out.returncode == 0, out.stderr
