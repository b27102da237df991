"""The port's examples run on the CPU and assert their own invariants.

``examples/torch_quickstart.py``, ``torch_failover_demo.py`` and
``torch_replicated_kv.py`` each take ``--device`` (the card by default) and
raise where there is no card unless ``--device cpu`` is given.  ``runpy``
runs each file as ``python examples/<name> --device cpu`` would.
"""

from __future__ import annotations

import pathlib
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
NAMES = ["torch_quickstart.py", "torch_failover_demo.py", "torch_replicated_kv.py"]
LAST = {
    "torch_quickstart.py": "OK: 7 values decided in order, none lost.",
    "torch_failover_demo.py": "all failure paths exercised; no value lost, no double delivery",
    "torch_replicated_kv.py": "after membership churn: user=bob",
}


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    out = capsys.readouterr().out
    assert out.startswith("dataplane on cpu")
    assert LAST[name] in out.strip().splitlines()[-1]


@pytest.mark.parametrize("name", NAMES)
def test_example_means_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        runpy.run_path(str(EXAMPLES / name), run_name="__main__")
