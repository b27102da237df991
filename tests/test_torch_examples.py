"""The port's examples run on the CPU and assert their own invariants.

``examples/torch_quickstart.py``, ``torch_failover_demo.py``,
``torch_replicated_kv.py``, ``torch_train_100m.py`` and
``torch_serve_batch.py`` each take
``--device`` (the card by default) and raise where there is no card unless
``--device cpu`` is given.  ``runpy`` runs each file as ``python
examples/<name> --device cpu`` would; the training example at 9 steps of
batch 2 and 32 tokens (its own asserts: the loss falls over the run, every
step commits, the committed checkpoint restores, the log survives a
coordinator failover).
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


def test_training_example_runs_on_the_cpu(monkeypatch, capsys):
    name = "torch_train_100m.py"
    args = ["--steps", "9", "--batch", "2", "--seq", "32", "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", [name, *args])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("model: qwen3-100m, ") and out[0].endswith("on cpu")
    assert "committed 9/9 steps" in out[1]
    assert out[2].startswith("restart OK from committed checkpoint at step 5")
    assert out[-1].endswith("coordinator failover OK")


def test_serve_batch_example_runs_on_the_cpu(monkeypatch, capsys):
    """12 requests of 8 prompt tokens and 8 new ones at batch 4, served
    twice alike (the example's own assert)."""
    name = "torch_serve_batch.py"
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("served 12 requests / 96 tokens in ") and out[0].endswith("on cpu")
    assert "45 decode steps" in out[0]  # three chunks of 4, 15 steps each
    assert out[-1] == "deterministic across re-serve: OK"


@pytest.mark.parametrize("name", NAMES + ["torch_train_100m.py", "torch_serve_batch.py"])
def test_example_means_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        runpy.run_path(str(EXAMPLES / name), run_name="__main__")
